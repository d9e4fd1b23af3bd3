"""The port's fused conv3x3+BN+ReLU against the JAX package's kernel.

On the CPU the port's ``conv3x3_bn_relu`` runs its plain version; it is held
against the Pallas kernel in interpret mode and against the lax reference,
on the same numpy inputs. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.ops import conv_bn_relu as jax_ops
from pytorch_cifar_tpu_torch.ops import conv_bn_relu as port
from _torch_threads import torch_threads  # noqa: F401

# (n, h, w, cin, cout): the two interpret-mode shapes plus the stem's cin=3
SHAPES = [(3, 8, 8, 8, 16), (3, 4, 4, 16, 8), (2, 8, 8, 3, 8)]


def _inputs(shape, seed=0):
    n, h, w, cin, cout = shape
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rs.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32
    )
    scale = rs.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (0.1 * rs.standard_normal(cout)).astype(np.float32)
    return x, wt, scale, bias


def _port(x, wt, scale, bias, dtype=torch.float32):
    out = port.conv3x3_bn_relu(
        torch.from_numpy(x).to(dtype), torch.from_numpy(wt).to(dtype),
        torch.from_numpy(scale), torch.from_numpy(bias),
    )
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_interpret(shape):
    x, wt, scale, bias = _inputs(shape)
    want = np.asarray(
        jax_ops.conv3x3_bn_relu(
            jnp.asarray(x), jnp.asarray(wt), jnp.asarray(scale),
            jnp.asarray(bias), interpret=True,
        )
    )
    got = _port(x, wt, scale, bias).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_lax_reference(shape):
    x, wt, scale, bias = _inputs(shape, seed=1)
    want = np.asarray(
        jax_ops.conv3x3_bn_relu_reference(
            jnp.asarray(x), jnp.asarray(wt), jnp.asarray(scale),
            jnp.asarray(bias),
        )
    )
    got = _port(x, wt, scale, bias).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the wrapper on a CPU tensor IS the plain version
    plain = port.conv3x3_bn_relu_reference(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(scale),
        torch.from_numpy(bias),
    ).numpy()
    np.testing.assert_array_equal(got, plain)


def test_bf16_io_keeps_dtype_and_matches_fp32_sum():
    """bf16 in, bf16 out, summed in fp32: the result is the fp32 function of
    the bf16-rounded inputs, rounded once (within one bf16 step)."""
    x, wt, scale, bias = _inputs((2, 8, 8, 16, 16), seed=2)
    got = _port(x, wt, scale, bias, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    xr = torch.from_numpy(x).bfloat16().float().numpy()
    wr = torch.from_numpy(wt).bfloat16().float().numpy()
    want = np.asarray(
        jax_ops.conv3x3_bn_relu_reference(
            jnp.asarray(xr), jnp.asarray(wr), jnp.asarray(scale),
            jnp.asarray(bias),
        )
    )
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=2 ** -7, atol=1e-6
    )


def test_fold_batchnorm_matches_jax():
    rs = np.random.RandomState(3)
    c = 64
    gamma, beta = rs.uniform(0.5, 1.5, c), rs.standard_normal(c)
    mean, var = rs.standard_normal(c), rs.uniform(0.1, 2.0, c)
    args = [a.astype(np.float32) for a in (gamma, beta, mean, var)]
    want = jax_ops.fold_batchnorm(*[jnp.asarray(a) for a in args])
    got = port.fold_batchnorm(*[torch.from_numpy(a) for a in args])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_cpu_tensor_never_launches():
    before = port.LAUNCHES
    x, wt, scale, bias = _inputs((2, 4, 4, 8, 8))
    _port(x, wt, scale, bias)
    _port(x, wt, scale, bias, dtype=torch.bfloat16)
    assert port.LAUNCHES == before


def test_non_cpu_tensor_never_reaches_plain_version():
    """A tensor off the CPU launches the kernel or raises — here a meta
    tensor, which no kernel takes, must raise rather than compute."""
    x, wt, scale, bias = _inputs((2, 4, 4, 8, 8))
    args = [torch.from_numpy(a) for a in (x, wt, scale, bias)]
    with pytest.raises(ValueError, match="CUDA"):
        port.conv3x3_bn_relu(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        port.conv3x3_bn_relu(*[a.to("meta") for a in args])


def test_rejects_bad_shapes_and_layouts():
    x, wt, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 4, 4, 8, 8)))
    with pytest.raises(ValueError):
        port.conv3x3_bn_relu(x, wt[:, :, :4], scale, bias)  # cin mismatch
    with pytest.raises(ValueError):
        port.conv3x3_bn_relu(x, wt, scale[:4], bias)
    with pytest.raises(ValueError, match="contiguous"):
        # an NCHW-contiguous tensor viewed as NHWC is not the kernel's layout
        port.conv3x3_bn_relu(
            x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
            wt, scale, bias,
        )
