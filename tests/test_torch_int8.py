"""The port's int8 weight-only serving lane against the JAX package's.

- ``quantize_int8`` on the port's ``state_dict`` gives JAX's ``q`` and
  ``s`` bit for bit: JAX's encoding, mapped leaf by leaf through
  ``compat.state_dict_from_jax`` (``q`` as its values, ``s`` broadcast
  over its kernel), equals the port's;
- an int8 engine's fp32 logits are within rtol 1e-4 of JAX's int8
  engine's on the same weights;
- JAX's two int8 engine tests (``tests/test_serve.py``) on the port: the
  lane is close to, not equal to, the float engine; its compile count,
  counters and the float-tree swap contract; a wrong-dtype tree refused.
  Their padding check runs on ResNet-18 here (every bucket size against
  the unpadded forward): LeNet's linear layers on the CPU backend are not
  batch-invariant (2e-8 at n = 3, the float engine's too);
- across all 44 registry names (``test_torch_int8_zoo*.py``), an int8
  engine's folded tree holds every weight as int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.serve.engine import InferenceEngine as JaxEngine
from pytorch_cifar_tpu.serve.engine import quantize_int8 as jax_quantize
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.serve import InferenceEngine
from pytorch_cifar_tpu_torch.serve.engine import (
    _is_qleaf,
    dequantize_int8,
    quantize_int8,
)
from _torch_ckpt import jax_state
from _torch_threads import torch_threads  # noqa: F401


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def _jax_trees(name, seed=0):
    st = jax_state(name, seed)
    return st.params, st.batch_stats


def _mapped(name, jq, stats, leaf_fn):
    """JAX's int8 encoding ``jq`` through ``compat``, each {q, s} leaf
    replaced by ``leaf_fn(leaf)`` (a float array of the kernel's shape)."""
    tree = jax.tree_util.tree_map(
        lambda l: leaf_fn(l) if _is_qleaf(l) else l, jq, is_leaf=_is_qleaf)
    return state_dict_from_jax(name, tree, stats)


@pytest.mark.parametrize(
    "name", ["LeNet", "ResNet18", "MobileNet", "GoogLeNet"])
def test_quantize_matches_jax_bit_for_bit(name):
    params, stats = _jax_trees(name)
    jq = jax_quantize(jax.device_get(params))
    port = quantize_int8(state_dict_from_jax(name, params, stats))
    want_q = _mapped(name, jq, stats, lambda l: l["q"].astype(np.float32))
    want_s = _mapped(name, jq, stats, lambda l: np.broadcast_to(
        l["s"], l["q"].shape).astype(np.float32))
    n_q = 0
    for key, v in port.items():
        if not _is_qleaf(v):
            assert np.asarray(v).ndim < 2, key
            continue
        n_q += 1
        assert v["q"].dtype == np.int8 and v["s"].dtype == np.float32
        assert v["s"].shape == (v["q"].shape[0],) + (1,) * (v["q"].ndim - 1)
        np.testing.assert_array_equal(v["q"], want_q[key].astype(np.int8))
        assert np.array_equal(
            np.broadcast_to(v["s"], v["q"].shape).view(np.uint32),
            np.ascontiguousarray(want_s[key]).view(np.uint32)), key
    assert n_q == sum(1 for l in jax.tree_util.tree_leaves(
        jq, is_leaf=_is_qleaf) if _is_qleaf(l))


def test_dequantize_is_q_times_s_at_the_compute_dtype():
    """JAX casts both factors to the compute dtype, then multiplies: in
    bf16 that is one rounding of the exact product of q and bf16(s)."""
    rs = np.random.RandomState(0)
    q = torch.from_numpy(rs.randint(-127, 128, (6, 5, 3, 3)).astype(np.int8))
    s = torch.from_numpy(rs.uniform(1e-3, 1e-1, (6, 1, 1, 1))
                         .astype(np.float32))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = dequantize_int8({"w": {"q": q, "s": s.to(dt)}}, dt)["w"]
        want = np.asarray(
            (jnp.asarray(q.numpy()).astype(jdt)
             * jnp.asarray(s.numpy()).astype(jdt)).astype(jnp.float32))
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name", ["LeNet", "MobileNet", "ResNet18"])
def test_int8_engine_matches_jax_int8_engine_fp32(name):
    params, stats = _jax_trees(name, seed=1)
    jeng = JaxEngine(name, params, stats, buckets=(4,),
                     compute_dtype=jnp.float32, int8=True)
    peng = InferenceEngine.from_jax(name, params, stats, buckets=(4,),
                                    compute_dtype=torch.float32,
                                    device="cpu", int8=True)
    x = _images(3, seed=1)
    want, got = jeng.predict(x), peng.predict(x)
    assert got.dtype == np.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # and the lane is not the float engine
    fp = InferenceEngine.from_jax(name, params, stats, buckets=(4,),
                                  compute_dtype=torch.float32, device="cpu")
    assert not np.array_equal(fp.predict(x), got)


def test_int8_engine_close_to_fp_and_internally_bit_stable():
    """JAX's test of the same name: same seed and buckets as the float
    engine, logits within the weight-only int8 envelope (not equal),
    compile count pinned, the float-tree swap contract intact, the lane's
    counters moved."""
    fp = InferenceEngine.from_random(
        "LeNet", buckets=(1, 4), compute_dtype=torch.float32, device="cpu")
    reg = MetricsRegistry()
    q = InferenceEngine.from_random(
        "LeNet", buckets=(1, 4), compute_dtype=torch.float32, int8=True,
        registry=reg, device="cpu")
    x = _images(3, seed=90)
    fp_out, q_out = fp.predict(x), q.predict(x)
    err = float(np.max(np.abs(fp_out - q_out)))
    scale = float(np.max(np.abs(fp_out)))
    assert 0 < err <= 0.05 * scale + 1e-6, (err, scale)
    assert q.compile_count == 2
    # weights_host returns FLOAT originals that swap back in to the
    # identical served bits
    host = q.weights_host()
    assert all(v.dtype != np.int8 for v in host.values())
    q.swap_weights(host)
    assert np.array_equal(q.predict(x), q_out)
    s = reg.summary()
    assert s["serve.int8_requests"] >= 2
    assert s["serve.int8_images"] >= 6


def test_int8_engine_rejects_mismatched_raw_trees():
    """The swap gate fires on a wrong-dtype tree: the comparison is
    against the RAW avals, not the quantized encoding."""
    q = InferenceEngine.from_random(
        "LeNet", buckets=(1,), compute_dtype=torch.float32, int8=True,
        device="cpu")
    bad = {k: v.astype(np.float64) if v.ndim >= 2 else v
           for k, v in q.weights_host().items()}
    with pytest.raises(ValueError, match="refusing weight swap"):
        q.swap_weights(bad)


@pytest.fixture(scope="module")
def resnet18_int8():
    return InferenceEngine.from_random(
        "ResNet18", seed=0, buckets=(1, 4, 8), compute_dtype=torch.float32,
        device="cpu", int8=True)


@pytest.mark.parametrize("n", [2, 3, 5, 7])
def test_int8_padding_bit_identical_within_lane(resnet18_int8, n):
    x = _images(n, seed=10 + n)
    np.testing.assert_array_equal(resnet18_int8.predict(x),
                                  resnet18_int8.direct_forward(x))


def test_int8_weights_host_is_the_float_originals(resnet18_int8):
    """The third JAX quirk carried over: an int8 engine's weights_host is
    the float state it was given, bit for bit, not its int8 encoding."""
    from pytorch_cifar_tpu_torch.models import create_model

    g = torch.Generator().manual_seed(0)
    want = create_model("ResNet18", generator=g).state_dict()
    host = resnet18_int8.weights_host()
    assert list(host) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(host[k], v.numpy())
