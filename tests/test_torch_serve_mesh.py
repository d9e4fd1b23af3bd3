"""The port's engine over a device group, on the CPU (logical shards).

Held against the JAX package's mesh engine on its 8 forced CPU devices
(``tests/conftest.py``), with LeNet's weights carried across by ``compat``:

- ``round_buckets``, the rounded buckets (the 2·D floor, the singleton
  bucket of D rows for n = 1), ``bucket_for`` and ``shard_split`` are
  JAX's exactly for D = 2, 4 and 8;
- the sharded engine gives every row the single engine's bits at n = 1,
  2, 3, 5, 8, 11, 16, 19 and 33, and stays within rtol 1e-4 of JAX's mesh
  engine;
- the micro-batcher rounds ``max_batch`` up to the shard multiple and
  observes ``serve.shard_images``, as JAX's does;
- a hot reload swaps every device's copy with no new compile;
- the cold-start cache's key carries the topology, and more cards than
  are visible are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.parallel import make_mesh
from pytorch_cifar_tpu.serve import InferenceEngine as JaxEngine
from pytorch_cifar_tpu.serve import MicroBatcher as JaxBatcher
from pytorch_cifar_tpu.serve.engine import round_buckets as jax_round
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.serve import InferenceEngine, MicroBatcher
from pytorch_cifar_tpu_torch.serve.engine import round_buckets, shard_devices
from _torch_threads import torch_threads  # noqa: F401

BUCKETS = (1, 8, 16)
NS = (1, 2, 3, 5, 8, 11, 16, 19, 33)  # JAX tests/test_serve.py:596
DEVICES = (2, 4, 8)


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def lenet():
    """LeNet's JAX trees and the port's ``state_dict`` of them."""
    from pytorch_cifar_tpu.models import create_model as jax_create_model

    variables = jax_create_model("LeNet").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    params = jax.device_get(dict(variables["params"]))
    return params, state_dict_from_jax("LeNet", params, {})


def _port(sd, d, **kw):
    return InferenceEngine("LeNet", sd, buckets=BUCKETS,
                           compute_dtype=torch.float32, device="cpu",
                           num_devices=d, **kw)


@pytest.fixture(scope="module")
def single(lenet):
    return _port(lenet[1], 1)


def test_round_buckets_is_jax_s():
    for buckets, m in (((1, 8, 32, 128), 8), ((3, 5), 4), ((8,), 1),
                       ((7, 8, 9), 8), ((1, 2, 3), 2)):
        assert round_buckets(buckets, m) == jax_round(buckets, m)


@pytest.mark.parametrize("d", DEVICES)
def test_buckets_and_shard_split_are_jax_s(lenet, d):
    params, sd = lenet
    for buckets in (BUCKETS, (1, 4, 32), (8, 32, 128), (1,)):
        jeng = JaxEngine("LeNet", params, {}, buckets=buckets,
                         compute_dtype=jnp.float32, mesh=make_mesh(d),
                         warmup=False)
        peng = InferenceEngine("LeNet", sd, buckets=buckets,
                               compute_dtype=torch.float32, device="cpu",
                               num_devices=d)
        assert peng.n_devices == jeng.n_devices == d
        assert peng.buckets == jeng.buckets, buckets
        for n in range(1, 70):
            assert peng.bucket_for(n) == jeng.bucket_for(n), (buckets, n)
            assert peng.shard_split(n) == jeng.shard_split(n), (buckets, n)
            assert sum(peng.shard_split(n)) == n
        assert peng.compile_count == len(peng.buckets)


@pytest.mark.parametrize("d", DEVICES)
def test_sharded_engine_bit_identical_to_single(lenet, single, d):
    sharded = _port(lenet[1], d)
    for n in NS:
        x = _images(n, seed=100 + n)
        a, b = single.predict(x), sharded.predict(x)
        assert a.shape == b.shape == (n, 10)
        assert np.array_equal(a, b), f"n={n} diverged at D={d}"
        assert np.array_equal(sharded.direct_forward(x), single.
                              direct_forward(x))


def test_sharded_engine_within_rtol_of_jax_mesh_engine(lenet):
    params, sd = lenet
    jeng = JaxEngine("LeNet", params, {}, buckets=BUCKETS,
                     compute_dtype=jnp.float32, mesh=make_mesh(8))
    peng = _port(sd, 8)
    assert peng.buckets == jeng.buckets == (8, 16)
    for n in NS:
        x = _images(n, seed=200 + n)
        np.testing.assert_allclose(peng.predict(x), jeng.predict(x),
                                   rtol=1e-4, atol=1e-5)


def test_batcher_rounds_max_batch_and_observes_shard_images(lenet, single):
    params, sd = lenet
    sharded = _port(sd, 4)
    jeng = JaxEngine("LeNet", params, {}, buckets=BUCKETS,
                     compute_dtype=jnp.float32, mesh=make_mesh(4),
                     warmup=False)
    for max_batch in (None, 10, 4, 1):
        jb = JaxBatcher(jeng, max_batch=max_batch, autostart=False)
        pb = MicroBatcher(sharded, max_batch=max_batch, autostart=False)
        assert pb.max_batch == jb.max_batch, max_batch
    batcher = MicroBatcher(sharded, max_batch=10, max_wait_ms=50.0)
    try:
        assert batcher.max_batch == 12
        xs = [_images(n, seed=n) for n in (3, 4, 2)]
        futs = [batcher.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            assert np.array_equal(f.result(timeout=60), single.predict(x))
    finally:
        batcher.close()
    hist = batcher.obs.snapshot()["histograms"]["serve.shard_images"]
    batches = batcher.stats["batches"]
    assert hist["count"] == 4 * batches and hist["sum"] == 9


def test_hot_reload_swaps_every_device_with_no_new_compile(lenet):
    sd = lenet[1]
    sharded = _port(sd, 4)
    compiles = sharded.compile_count
    new = create_model("LeNet", generator=torch.Generator().manual_seed(7))
    new_sd = {k: v.numpy() for k, v in new.state_dict().items()}
    version = sharded.swap_weights(new_sd)
    assert version == sharded.version == 1
    assert sharded.compile_count == compiles
    ref = _port(new_sd, 1)
    for n in (1, 5, 16, 19):
        x = _images(n, seed=300 + n)
        assert np.array_equal(sharded.predict(x), ref.predict(x))
    copies = sharded._weights.copies
    assert len(copies) == 4 and all(c is copies[0] for c in copies)
    with pytest.raises(ValueError, match="refusing weight swap"):
        sharded.swap_weights({k: v for k, v in list(new_sd.items())[1:]})
    assert sharded.version == 1


def test_cache_key_carries_the_topology_and_a_topology_misses(lenet,
                                                              tmp_path):
    sd = lenet[1]
    one = _port(sd, 1, aot_cache_dir=str(tmp_path))
    assert (one.compile_count, one.aot_cache_misses) == (3, 3)
    key = one._cache_key_fields(8)
    assert (key["n_devices"], key["process_count"], key["process_index"],
            key["devices"]) == (1, 1, 0, ["cpu"])
    two = _port(sd, 2, aot_cache_dir=str(tmp_path))
    assert two._cache_key_fields(8)["devices"] == ["cpu", "cpu"]
    assert (two.compile_count, two.aot_cache_hits) == (3, 0)
    again = _port(sd, 2, aot_cache_dir=str(tmp_path))
    assert (again.compile_count, again.aot_cache_hits) == (0, 3)
    x = _images(19, seed=4)
    assert np.array_equal(again.predict(x), one.predict(x))


def test_more_cards_than_visible_are_refused():
    with pytest.raises(ValueError, match="CUDA device"):
        shard_devices(torch.device("cuda"), 2)
    with pytest.raises(ValueError, match="num_devices must be >= 1"):
        shard_devices(torch.device("cpu"), 0)
    assert shard_devices(torch.device("cpu"), 3) == [torch.device("cpu")] * 3
