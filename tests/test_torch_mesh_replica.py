"""The port's multi-process replica (``serve/mesh_replica.py``) on the CPU.

- One process (no process group): the replica is the engine's semantics,
  through it and through the micro-batcher; a wrong-model swap is refused
  on the caller's thread before anything reaches the dispatch thread;
  ``/healthz`` carries its mesh block; ``close`` leaves no thread and
  refuses new work.
- The watchdog turns a collective that never completes into
  ``exit_fn(PEER_TIMEOUT_RC)`` within its bound (an injected ``exit_fn``).
- Two ranks over gloo in child processes (``tests/_torch_mesh.py``): the
  follower starts from other weights and serves the leader's after the
  bootstrap broadcast; every answer is bit for bit a one-process engine's;
  a swap lands the same generation on both ranks; and a second start on
  the cold-start cache joins at ``compiles == 0`` on both ranks.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.serve import (
    BatcherBackend,
    InferenceEngine,
    MeshReplica,
    MeshReplicaClosed,
    MicroBatcher,
    PEER_TIMEOUT_RC,
)
from pytorch_cifar_tpu_torch.serve.mesh_replica import _Watchdog
from _torch_mesh import run_pair
from _torch_threads import torch_threads  # noqa: F401


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def _state(seed, name="LeNet"):
    model = create_model(name, generator=torch.Generator().manual_seed(seed))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _engine(seed=0, **kw):
    return InferenceEngine("LeNet", _state(seed), buckets=(1, 4, 8),
                           compute_dtype=torch.float32, device="cpu", **kw)


def _mesh_threads():
    return [t for t in threading.enumerate()
            if t.name in ("mesh-dispatch", "mesh-watchdog")]


def test_one_process_replica_is_the_engine():
    eng, ref = _engine(num_devices=2), _engine()
    replica = MeshReplica(eng, timeout_s=5.0)
    try:
        assert (replica.process_count, replica.is_leader) == (1, True)
        assert replica.barrier_generation == 1
        assert replica.buckets == eng.buckets == (2, 4, 8)
        for n in (1, 2, 3, 5, 8, 9, 17):
            x = _images(n, seed=n)
            assert np.array_equal(replica.predict(x), ref.predict(x))
        assert replica.compile_count == eng.compile_count == 3
        health = replica.mesh_health()
        assert health == {"process_count": 1, "process_index": 0,
                          "local_devices": 2, "global_devices": 2,
                          "barrier_generation": 1, "timeout_s": 5.0,
                          "engine_version": 0}
    finally:
        replica.close()
    with pytest.raises(MeshReplicaClosed):
        replica.predict(_images(1))
    replica.close()  # idempotent
    assert not _mesh_threads()


def test_replica_through_the_batcher_and_the_health_block():
    eng, ref = _engine(), _engine()
    replica = MeshReplica(eng, timeout_s=5.0)
    batcher = MicroBatcher(replica, max_wait_ms=20.0)
    try:
        assert batcher.max_batch == 8
        xs = [_images(n, seed=20 + n) for n in (1, 3, 2, 8)]
        futs = [batcher.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            assert np.array_equal(f.result(timeout=60), ref.predict(x))
        health = BatcherBackend(replica, batcher).health()
        assert health["mesh"]["barrier_generation"] == 1
        assert health["n_devices"] == 1 and health["compiles"] == 3
    finally:
        batcher.close()
        replica.close()
    assert not _mesh_threads()


def test_wrong_model_swap_is_refused_before_any_broadcast():
    eng = _engine()
    replica = MeshReplica(eng, timeout_s=5.0)
    try:
        seq = replica._seq
        with pytest.raises(ValueError, match="refusing weight swap"):
            replica.swap_weights(_state(0, name="ResNet18"))
        assert replica._seq == seq and replica._queue.empty()
        assert eng.version == 0
        assert replica.swap_weights(_state(3)) == 1
        ref = _engine(seed=3)
        x = _images(5, seed=5)
        assert np.array_equal(replica.predict(x), ref.predict(x))
    finally:
        replica.close()


def test_watchdog_exits_within_its_bound_and_disarm_holds_it():
    calls = []
    dog = _Watchdog(0.3, exit_fn=calls.append, interval_s=0.02)
    dog.start()
    try:
        dog.arm("a collective that never completes")
        t0 = time.monotonic()
        while not calls and time.monotonic() - t0 < 5.0:
            time.sleep(0.01)
        assert calls == [PEER_TIMEOUT_RC] == [70]
        assert 0.3 <= time.monotonic() - t0 < 2.0
    finally:
        dog.stop()
    quiet = []
    dog = _Watchdog(0.2, exit_fn=quiet.append, interval_s=0.02)
    dog.start()
    try:
        for _ in range(10):  # re-armed faster than its bound: never fires
            dog.arm("heartbeat")
            time.sleep(0.05)
        dog.disarm()
        time.sleep(0.4)
        assert quiet == []
    finally:
        dog.stop()


def test_two_rank_gloo_pair_serves_the_single_engine_s_bits():
    leader, follower = run_pair()
    assert leader["buckets"] == follower["buckets"] == [2, 4]
    assert leader["bits_identical"] and leader["swapped_bits_identical"]
    # the bootstrap swap, then the hot reload: the same generation
    assert leader["swap_version"] == leader["version"] == 2
    assert follower["version"] == 2
    assert leader["health"]["process_count"] == 2
    assert leader["health"]["global_devices"] == 2
    assert leader["barrier_generation"] == follower["barrier_generation"] == 1
    assert (leader["compiles"], follower["compiles"]) == (2, 2)


def test_two_rank_pair_warm_starts_on_the_cache_at_zero_compiles(tmp_path):
    cache = str(tmp_path / "aot")
    first = run_pair(cache)
    assert [r["compiles"] for r in first] == [2, 2]
    again = run_pair(cache)
    assert [(r["compiles"], r["hits"]) for r in again] == [(0, 2), (0, 2)]
    assert again[0]["bits_identical"]
