"""The training slice's kernels and BatchNorm against the JAX package.

On the CPU, the port's ``dma_row_gather`` (K1) and ``fused_moments`` (K2)
run their plain versions; they are held against the Pallas kernels in
interpret mode and against ``jnp.take``/autodiff, on the same numpy
inputs. The port's train-mode ``BatchNorm`` is held against the JAX
``BatchNorm``, with and without the ``bn_moments_impl`` hook. The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models.common import BatchNorm as JaxBatchNorm
from pytorch_cifar_tpu.models.common import bn_moments_impl as jax_hook
from pytorch_cifar_tpu.ops import bn_stats as jax_bn_stats
from pytorch_cifar_tpu.ops import dma_gather as jax_gather
from pytorch_cifar_tpu_torch.models.common import BatchNorm, bn_moments_impl
from pytorch_cifar_tpu_torch.ops import bn_stats, dma_gather
from _torch_threads import torch_threads  # noqa: F401

# -- K1: dma_row_gather --------------------------------------------------


@pytest.mark.parametrize(
    "rows,dtype,m,block",
    [((96, 32, 32, 3), np.uint8, 128, 2048),  # the CIFAR row, 3072 B
     ((40, 8, 128), np.float32, 72, 48)],     # m > block, no 1024 divisor
    ids=["cifar_uint8", "f32_block_rounding"],
)
def test_gather_plain_matches_pallas_interpret(rows, dtype, m, block):
    rs = np.random.RandomState(0)
    imgs = (rs.randint(0, 256, size=rows) if dtype == np.uint8
            else rs.rand(*rows)).astype(dtype)
    idx = rs.randint(0, rows[0], size=(m,)).astype(np.int32)
    want = np.asarray(jax_gather.dma_row_gather(
        jnp.asarray(imgs), jnp.asarray(idx), block=block, interpret=True
    ))
    got = dma_gather.dma_row_gather(
        torch.from_numpy(imgs), torch.from_numpy(idx)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.take(imgs, idx, axis=0))


def test_gather_rows_the_jax_kernel_refuses_match_take():
    """A 252-byte row (7 x 9 float32) is outside the Pallas kernel's
    (k*8, 128) tiling; the port has no such precondition."""
    rs = np.random.RandomState(1)
    imgs = rs.rand(16, 7, 9).astype(np.float32)
    idx = rs.randint(0, 16, size=(40,)).astype(np.int32)
    with pytest.raises(ValueError, match="cannot tile"):
        jax_gather.dma_row_gather(jnp.asarray(imgs), jnp.asarray(idx),
                                  interpret=True)
    got = dma_gather.dma_row_gather(
        torch.from_numpy(imgs), torch.from_numpy(idx)
    ).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jnp.take(jnp.asarray(imgs), jnp.asarray(idx), 0))
    )


def test_gather_vector_path_is_decided_from_data_ptr():
    """16-byte copies only when the row's bytes and both base addresses
    are multiples of 16; otherwise the byte path."""
    imgs = torch.zeros(4, 32, 32, 3, dtype=torch.uint8)
    out = torch.empty_like(imgs)
    assert dma_gather.vector_path(imgs, out)
    rows252 = torch.zeros(4, 7, 9)
    assert not dma_gather.vector_path(rows252, torch.empty_like(rows252))
    shifted = torch.zeros(4 * 3072 + 1, dtype=torch.uint8)[1:].view(
        4, 32, 32, 3
    )
    assert shifted.data_ptr() % 16 != 0
    assert not dma_gather.vector_path(shifted, out)
    assert not dma_gather.vector_path(imgs, shifted)


def test_gather_cpu_never_launches_and_checks_inputs():
    before = dma_gather.LAUNCHES
    imgs = torch.arange(24, dtype=torch.uint8).view(6, 4)
    idx = torch.tensor([5, 0, 5], dtype=torch.int32)
    assert torch.equal(dma_gather.dma_row_gather(imgs, idx), imgs[[5, 0, 5]])
    assert dma_gather.LAUNCHES == before
    with pytest.raises(TypeError, match="int32"):
        dma_gather.dma_row_gather(imgs, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        dma_gather.dma_row_gather(imgs.t(), idx)
    with pytest.raises(ValueError, match="CUDA"):
        dma_gather.dma_row_gather(imgs.to("meta"), idx.to("meta"))


def test_gather_empty_idx_gives_no_rows():
    """An empty index gathers an empty block of the row shape, as
    ``jnp.take`` does, and launches nothing."""
    before = dma_gather.LAUNCHES
    imgs = np.arange(24, dtype=np.float32).reshape(6, 2, 2)
    idx = np.zeros((0,), np.int32)
    got = dma_gather.dma_row_gather(torch.from_numpy(imgs),
                                    torch.from_numpy(idx))
    want = np.asarray(jnp.take(jnp.asarray(imgs), jnp.asarray(idx), 0))
    assert got.shape == want.shape == (0, 2, 2) and got.dtype == torch.float32
    assert dma_gather.LAUNCHES == before


# -- K2: fused_moments ---------------------------------------------------

MOMENT_SHAPES = [(4, 8, 8, 16), (8, 4, 4, 256), (6, 8, 8, 130),
                 (4, 4, 4, 512)]
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp32": (torch.float32, jnp.float32)}


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("shape", MOMENT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_moments_plain_matches_pallas_interpret(shape, dname):
    tdt, jdt = DTYPES[dname]
    x = np.random.RandomState(2).standard_normal(shape).astype(np.float32)
    want = jax_bn_stats.fused_moments(jnp.asarray(x).astype(jdt), True)
    got = bn_stats.fused_moments(torch.from_numpy(x).to(tdt))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (shape[-1],)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_moments_gradient_matches_jax_grad(dname):
    """The autograd.Function's backward (a/n + 2bx/n) against jax.grad
    through the Pallas kernel's custom VJP, same cotangents."""
    tdt, jdt = DTYPES[dname]
    rs = np.random.RandomState(3)
    x = rs.standard_normal((4, 8, 8, 16)).astype(np.float32)
    a, b = (rs.standard_normal(16).astype(np.float32) for _ in range(2))

    def jax_loss(v):
        m, sq = jax_bn_stats.fused_moments(v, True)
        return jnp.sum(m * a) + jnp.sum(sq * b)

    want = jax.grad(jax_loss)(jnp.asarray(x).astype(jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    m, sq = bn_stats.fused_moments(xt)
    ((m * torch.from_numpy(a)).sum() + (sq * torch.from_numpy(b)).sum()
     ).backward()
    assert xt.grad.dtype == tdt
    np.testing.assert_allclose(
        xt.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=0, atol=1e-5,
    )


def test_moments_cpu_never_launches_and_checks_layout():
    before = bn_stats.LAUNCHES
    x = torch.randn(2, 4, 4, 8)
    bn_stats.fused_moments(x)
    assert bn_stats.LAUNCHES == before
    with pytest.raises(ValueError, match="contiguous"):
        bn_stats.fused_moments(x.permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="NHWC"):
        bn_stats.fused_moments(x[0])
    with pytest.raises(ValueError, match="CUDA"):
        bn_stats.fused_moments(x.to("meta"))


# -- train-mode BatchNorm ------------------------------------------------


def _bn_case(c, seed):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal((8, 6, 6, c)) * 2 + 0.5).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * rs.standard_normal(c)).astype(np.float32)
    mean = (0.1 * rs.standard_normal(c)).astype(np.float32)
    var = rs.uniform(0.5, 1.5, c).astype(np.float32)
    return x, scale, bias, mean, var


def _jax_bn(x, scale, bias, mean, var, hook=None):
    bn = JaxBatchNorm(use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    if hook is None:
        y, st = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    else:
        with jax_hook(hook):
            y, st = bn.apply(variables, jnp.asarray(x),
                             mutable=["batch_stats"])
    s = st["batch_stats"]
    return np.asarray(y), np.asarray(s["mean"]), np.asarray(s["var"])


def _port_bn(x, scale, bias, mean, var, hook=None):
    bn = BatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last NCHW
    with bn_moments_impl(hook):
        y = bn(xt).permute(0, 2, 3, 1)
    return (y.detach().numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy())


@pytest.mark.parametrize("c", [16, 130])
def test_batchnorm_train_matches_jax(c):
    """Output (biased one-pass variance), running mean and the running var
    updated with the unbiased variance, after one update, fp32."""
    case = _bn_case(c, seed=4)
    for got, want in zip(_port_bn(*case), _jax_bn(*case)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_batchnorm_hook_keeps_semantics():
    """With bn_moments_impl(fused_moments) the port's BatchNorm gives the
    same output and running stats as without, and as the JAX BatchNorm
    under its own hook (the pattern of tests/test_ops.py)."""
    case = _bn_case(16, seed=5)
    stock = _port_bn(*case)
    hooked = _port_bn(*case, hook=bn_stats.fused_moments)
    jax_hooked = _jax_bn(
        *case, hook=lambda v: jax_bn_stats.fused_moments(v, True)
    )
    for s, h, j in zip(stock, hooked, jax_hooked):
        np.testing.assert_allclose(h, s, rtol=0, atol=1e-5)
        np.testing.assert_allclose(h, j, rtol=0, atol=1e-5)


def test_batchnorm_hook_carries_gradients():
    """Gradients through the hooked BN equal the stock BN's (the backward
    of fused_moments replaces the reductions' autograd)."""
    x, scale, bias, mean, var = _bn_case(8, seed=6)
    grads = []
    for hook in (None, bn_stats.fused_moments):
        bn = BatchNorm(8)
        bn.train()
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        with bn_moments_impl(hook):
            y = bn(xt)
        (y * y).sum().backward()
        grads.append((xt.grad.clone(), bn.weight.grad.clone()))
    for g_stock, g_hook in zip(*grads):
        np.testing.assert_allclose(g_hook.numpy(), g_stock.numpy(),
                                   rtol=1e-5, atol=1e-5)
