"""The port's serving slice on the CPU: engine, batcher, load, CLI.

Held against the JAX package's ``InferenceEngine`` on the same weights
(mapped by ``compat.state_dict_from_jax``), and against the engine's own
contracts: bucket padding does not change answers, warmup is the only
thing that counts in ``compile_count``, a wrong-model swap is refused.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu.serve.engine import InferenceEngine as JaxEngine
from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.data.pipeline import StagingPool
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.serve import (
    BatcherClosed,
    DeadlineExceeded,
    InferenceEngine,
    MicroBatcher,
    QueueFull,
    run_load,
)
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (1, 4, 8)


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def _jax_trees(seed=0):
    """ResNet18 (params, batch_stats) as numpy from ``seed``, with
    non-trivial BN affine and running statistics."""
    shapes = jax.eval_shape(
        lambda: jax_create_model("ResNet18").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False
        )
    )
    rs = np.random.RandomState(seed)

    def param(path, s):
        if path[-1].key == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rs.uniform(-bound, bound, s.shape).astype(np.float32)
        if path[-1].key == "scale":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    def stat(path, s):
        if path[-1].key == "var":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    return (
        jax.tree_util.tree_map_with_path(param, shapes["params"]),
        jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"]),
    )


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine.from_random(
        "ResNet18", seed=0, buckets=BUCKETS, compute_dtype=torch.float32,
        device="cpu",
    )


def test_port_engine_matches_jax_engine_fp32():
    params, stats = _jax_trees()
    jeng = JaxEngine(
        "ResNet18", params, stats, buckets=(4,), compute_dtype=jnp.float32
    )
    peng = InferenceEngine.from_jax(
        "ResNet18", params, stats, buckets=(4,), compute_dtype=torch.float32,
        device="cpu",
    )
    x = _images(3, seed=1)
    want, got = jeng.predict(x), peng.predict(x)
    assert got.dtype == np.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bf16_engine_close_to_fp32_engine():
    """bf16 compute, fp32 logits on the wire, within 2% of the largest
    fp32 logit (the JAX engine's bf16 policy)."""
    params, stats = _jax_trees(seed=2)
    x = _images(3, seed=2)
    e32, e16 = (
        InferenceEngine.from_jax(
            "ResNet18", params, stats, buckets=(4,), compute_dtype=dt,
            device="cpu",
        )
        for dt in (torch.float32, torch.bfloat16)
    )
    want, got = e32.predict(x), e16.predict(x)
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want)) <= 0.02 * np.max(np.abs(want))


def test_bucket_for_and_chunking(engine):
    assert [engine.bucket_for(n) for n in (1, 2, 4, 5, 8, 9, 100)] == [
        1, 4, 4, 8, 8, 8, 8
    ]
    assert engine.shard_split(19) == [8, 8, 3]
    x = _images(19, seed=3)
    out = engine.predict(x)
    assert out.shape == (19, 10)
    np.testing.assert_array_equal(
        out,
        np.concatenate([engine.predict(x[i : i + 8]) for i in (0, 8, 16)]),
    )


@pytest.mark.parametrize("n", [2, 3, 5, 7])
def test_padded_bucket_forward_bit_identical_to_direct(engine, n):
    x = _images(n, seed=10 + n)
    np.testing.assert_array_equal(engine.predict(x), engine.direct_forward(x))


def test_compile_count_pinned_after_predict(engine):
    assert engine.compile_count == len(BUCKETS)
    for n in (1, 3, 8, 11):
        engine.predict(_images(n))
    engine.direct_forward(_images(5))
    engine.warmup()  # idempotent
    assert engine.compile_count == len(BUCKETS)


def test_wrong_model_swap_raises_and_good_swap_round_trips():
    eng = InferenceEngine.from_random(
        "ResNet18", seed=0, buckets=(2,), compute_dtype=torch.float32,
        device="cpu",
    )
    x = _images(2, seed=4)
    before = eng.predict(x)
    with pytest.raises(ValueError, match="refusing weight swap"):
        eng.swap_weights(create_model("ResNet34").state_dict())
    assert eng.version == 0
    snapshot = eng.weights_host()
    other = create_model("ResNet18", generator=torch.Generator().manual_seed(1))
    assert eng.swap_weights(other.state_dict()) == 1
    assert not np.array_equal(eng.predict(x), before)
    eng.swap_weights(snapshot)  # the rollback snapshot swaps back exactly
    np.testing.assert_array_equal(eng.predict(x), before)
    assert eng.compile_count == 1


def test_predict_rejects_wrong_shape(engine):
    with pytest.raises(ValueError):
        engine.predict(np.zeros((2, 16, 16, 3), np.uint8))


def test_batcher_and_closed_loop_load(engine):
    batcher = MicroBatcher(engine, max_wait_ms=1.0)
    try:
        report = run_load(
            batcher, clients=3, requests_per_client=4, images_max=6, seed=0
        )
        x = _images(5, seed=5)
        np.testing.assert_array_equal(
            batcher.predict(x), engine.predict(x)
        )
    finally:
        batcher.close()
    assert report["failed"] == 0
    assert report["requests"] == 12
    assert report["images"] > 0 and report["p99_ms"] >= report["p50_ms"]
    assert engine.compile_count == len(BUCKETS)


def test_cli_prints_one_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_cifar_tpu_torch.serve",
         "--device", "cpu", "--dtype", "float32", "--buckets", "1", "4",
         "--clients", "2", "--requests", "2", "--verify"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["model"] == "ResNet18" and rec["platform"] == "cpu"
    assert rec["compiles"] == 2 and rec["failed"] == 0
    assert rec["requests"] == 4 and rec["kernel_launches"] == 0
    assert "verify: bucket-padded forward bit-identical" in proc.stderr


def test_cuda_is_the_default_device():
    """Entry points run on CUDA unless told otherwise; without CUDA they
    raise and name ``device="cpu"`` — never a silent CPU fallback."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine.from_random("ResNet18", buckets=(1,))
    assert resolve_device("cpu").type == "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_cifar_tpu_torch.serve",
         "--buckets", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and proc.stdout == ""
    assert "device='cpu'" in proc.stderr


class _GatedEngine:
    """Engine stand-in whose predict blocks until released: lets a test
    hold the batcher's worker inside one call while requests queue. It
    records the first row's tag of every dispatched batch."""

    buckets = (4,)

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.staging = StagingPool()
        self.heads = []

    def bucket_for(self, n):
        return 4

    def predict(self, x):
        self.entered.set()
        self.gate.wait(timeout=30)
        self.heads.append(int(x[0, 0, 0, 0]))
        return np.zeros((x.shape[0], 10), np.float32)


def _tagged(tag):
    return np.full((1, 32, 32, 3), tag, np.uint8)


def test_batcher_interactive_lane_dispatches_before_bulk():
    eng = _GatedEngine()
    batcher = MicroBatcher(eng, max_batch=1, max_wait_ms=0.0, max_queue=8)
    try:
        first = batcher.submit(_tagged(1))
        assert eng.entered.wait(10)
        bulk = [batcher.submit(_tagged(10 + i), priority="bulk")
                for i in range(3)]
        inter = batcher.submit(_tagged(2))
        eng.gate.set()
        for f in [first, inter, *bulk]:
            assert f.result(timeout=30).shape == (1, 10)
    finally:
        batcher.close()
    # the interactive request queued behind three bulk ones formed the
    # next batch; the bulk ones rode its bucket's slack (continuous)
    assert eng.heads == [1, 2]
    assert batcher.stats["bulk_requests"] == 3
    assert batcher.stats["continuous_admitted"] == 3


def test_batcher_deadline_and_bulk_cap():
    eng = _GatedEngine()
    batcher = MicroBatcher(eng, max_batch=1, max_wait_ms=0.0, max_queue=4)
    try:
        batcher.submit(_tagged(1))
        assert eng.entered.wait(10)
        expiring = batcher.submit(_tagged(2), deadline_ms=1.0)
        batcher.submit(_tagged(3), priority="bulk")
        batcher.submit(_tagged(4), priority="bulk")
        with pytest.raises(QueueFull):  # bulk holds at most half the queue
            batcher.submit(_tagged(5), priority="bulk")
        pending = batcher.submit(_tagged(6))
        time.sleep(0.05)
        eng.gate.set()
        with pytest.raises(DeadlineExceeded):
            expiring.result(timeout=30)
        pending.result(timeout=30)
    finally:
        eng.gate.set()
        batcher.close()
    assert batcher.stats["expired"] == 1
    with pytest.raises(BatcherClosed):
        batcher.submit(_tagged(9))


def test_batcher_close_without_drain_fails_queued_requests():
    eng = _GatedEngine()
    batcher = MicroBatcher(eng, max_batch=1, max_wait_ms=0.0, max_queue=4)
    try:
        running = batcher.submit(_tagged(1))
        assert eng.entered.wait(10)
        stranded = batcher.submit(_tagged(2))
        closer = threading.Thread(target=batcher.close,
                                  kwargs={"drain": False})
        closer.start()
        with pytest.raises(BatcherClosed):
            stranded.result(timeout=30)
        eng.gate.set()
        running.result(timeout=30)  # the call in flight still answers
        closer.join(timeout=30)
        assert not closer.is_alive()
    finally:
        eng.gate.set()
        batcher.close()
