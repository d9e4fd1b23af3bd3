"""The port's max-pool (K4) and depthwise-stencil (K5) ops against the JAX
package, on the CPU.

The same numpy-seeded inputs go through the JAX kernels (Pallas in
interpret mode, as ``tests/test_ops.py`` runs them) and their library
counterparts (``nn.max_pool``, ``depthwise_xla``), and through the port's
wrappers, which on a CPU tensor run the plain PyTorch versions. A max is
exact, so K4 is held bit for bit (integer cotangents keep the gradient sums
exact too); K5 sums in fp32 in another order than XLA: rtol/atol 2e-5, the
JAX package's own tolerance for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as jnn

from pytorch_cifar_tpu.ops.depthwise_stencil import (
    depthwise_stencil as jax_depthwise_stencil,
)
from pytorch_cifar_tpu.ops.depthwise_stencil import depthwise_xla
from pytorch_cifar_tpu.ops.max_pool import max_pool3x3_s1 as jax_max_pool3x3_s1
from pytorch_cifar_tpu_torch.models import common
from pytorch_cifar_tpu_torch.ops import _build
from pytorch_cifar_tpu_torch.ops import depthwise_stencil as D
from pytorch_cifar_tpu_torch.ops import max_pool as P

POOL_SHAPES = [(3, 8, 8, 16), (2, 5, 5, 130)]


def _xla_pool(x):
    return jnn.max_pool(x, (3, 3), strides=(1, 1), padding=[(1, 1), (1, 1)])


def _jax_pools():
    return {
        "pallas": lambda v: jax_max_pool3x3_s1(v, True),
        "xla": _xla_pool,
    }


def _port_grad(x, g):
    xt = torch.from_numpy(x).requires_grad_()
    out = P.max_pool3x3_s1(xt)
    (gi,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    return out.detach().numpy(), gi.numpy()


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build or load a kernel library fails the test."""
    def refuse(name):
        raise AssertionError(f"a CPU tensor asked for the {name} kernel")

    monkeypatch.setattr(_build, "load", refuse)


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_max_pool_forward_exact(shape, oracle, no_build):
    x = np.random.RandomState(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(_jax_pools()[oracle](jnp.asarray(x)))
    for grad in (False, True):  # without and with the winner map
        got = P.max_pool3x3_s1(torch.from_numpy(x).requires_grad_(grad))
        np.testing.assert_array_equal(got.detach().numpy(), want)


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_max_pool_gradient_exact_with_integer_cotangents(shape, oracle):
    """Tie-free fp32 data, integer cotangents: every gradient sum is exact
    in any order, so the routing must match bit for bit. Float cotangents
    agree to summation order (atol 1e-5)."""
    rs = np.random.RandomState(5)
    x = rs.standard_normal(shape).astype(np.float32)
    pool = _jax_pools()[oracle]
    _, vjp = jax.vjp(pool, jnp.asarray(x))
    g = np.round(rs.uniform(size=shape) * 8.0).astype(np.float32)
    np.testing.assert_array_equal(
        _port_grad(x, g)[1], np.asarray(vjp(jnp.asarray(g))[0])
    )
    gf = rs.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(
        _port_grad(x, gf)[1], np.asarray(vjp(jnp.asarray(gf))[0]), atol=1e-5
    )


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
def test_max_pool_gradient_tie_rule_first_max(oracle):
    """An all-equal input: the tie rule alone (row-major first maximum)
    decides every route."""
    x = np.ones((2, 6, 6, 8), np.float32)
    g = np.round(
        np.random.RandomState(9).uniform(size=x.shape) * 8.0
    ).astype(np.float32)
    _, vjp = jax.vjp(_jax_pools()[oracle], jnp.asarray(x))
    np.testing.assert_array_equal(
        _port_grad(x, g)[1], np.asarray(vjp(jnp.asarray(g))[0])
    )


def test_max_pool_matches_torch_max_pool2d_forward_and_backward():
    """The rule is also ``F.max_pool2d``'s: the model may swap one for the
    other without moving a value (tie-free data and the all-ties input)."""
    rs = np.random.RandomState(11)
    for x in (rs.standard_normal((2, 7, 5, 12)).astype(np.float32),
              np.ones((1, 4, 4, 3), np.float32)):
        g = np.round(rs.uniform(size=x.shape) * 8.0).astype(np.float32)
        xt = torch.from_numpy(x).requires_grad_()
        ref = F.max_pool2d(xt.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
        (gref,) = torch.autograd.grad(ref, xt, torch.from_numpy(g))
        out, gi = _port_grad(x, g)
        np.testing.assert_array_equal(out, ref.detach().numpy())
        np.testing.assert_array_equal(gi, gref.numpy())


def test_max_pool_winner_map_is_one_uint8_of_row_major_taps():
    x = np.random.RandomState(12).standard_normal((2, 5, 6, 7)).astype(
        np.float32
    )
    out, idx = P.max_pool3x3_s1_reference(torch.from_numpy(x), True)
    assert idx.dtype == torch.uint8 and idx.shape == out.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-np.inf)
    taps = np.stack([xp[:, t // 3:t // 3 + 5, t % 3:t % 3 + 6]
                     for t in range(9)])
    np.testing.assert_array_equal(idx.numpy(), taps.argmax(axis=0))
    assert P.max_pool3x3_s1_reference(torch.from_numpy(x))[1] is None


def test_max_pool_bf16_gradient_mass_conserved():
    """bf16 data ties often; every window's gradient still lands on exactly
    one input element, as in the JAX kernel's own bf16 test."""
    x = np.random.RandomState(6).standard_normal((2, 8, 8, 32)).astype(
        np.float32
    )
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = P.max_pool3x3_s1(xt)
    assert out.dtype == torch.bfloat16
    (gi,) = torch.autograd.grad(out, xt, torch.ones_like(out))
    assert gi.dtype == torch.bfloat16
    assert float(gi.float().sum()) == out.numel()
    _, vjp = jax.vjp(lambda v: jax_max_pool3x3_s1(v, True),
                     jnp.asarray(x).astype(jnp.bfloat16))
    (want,) = vjp(jnp.ones(x.shape, jnp.bfloat16))
    np.testing.assert_array_equal(
        gi.float().numpy(), np.asarray(want.astype(jnp.float32))
    )


def test_max_pool_propagates_nan_like_nn_max_pool():
    """A NaN wins every window that holds it (``nn.max_pool``'s and
    ``F.max_pool2d``'s behaviour), and gets that window's gradient; the TPU
    kernel's strict ``>`` would let it win only from tap 0."""
    x = np.random.RandomState(13).standard_normal((1, 5, 5, 2)).astype(
        np.float32
    )
    x[0, 2, 3, 1] = np.nan
    want = np.asarray(_xla_pool(jnp.asarray(x)))
    out, gi = _port_grad(x, np.ones_like(x))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
    np.testing.assert_array_equal(out[~np.isnan(want)], want[~np.isnan(want)])
    assert np.isnan(out[0, 1:4, 2:5, 1]).all() and np.isnan(out).sum() == 9
    assert gi[0, 2, 3, 1] == 9.0  # all nine windows route to the NaN
    tpu = np.asarray(jax_max_pool3x3_s1(jnp.asarray(x), True))
    assert np.isnan(tpu).sum() < 9  # the difference from the TPU kernel


def test_max_pool_all_neg_inf_map_drops_the_halo_gradient():
    """Every real tap -inf: tap 0 keeps the window, and where tap 0 lies
    outside the map the gradient is dropped (the TPU kernel's behaviour);
    inside, it goes to the window's top-left input."""
    x = torch.full((1, 3, 3, 1), float("-inf"))
    out, idx = P.max_pool3x3_s1_reference(x, True)
    assert torch.isinf(out).all() and int(idx.max()) == 0
    g = torch.ones_like(x)
    gi = P.max_pool3x3_s1_backward_reference(g, idx)
    want = torch.zeros(3, 3)
    want[:2, :2] = 1.0  # windows (1..2, 1..2) name inputs (0..1, 0..1)
    assert torch.equal(gi[0, :, :, 0], want)


def test_max_pool_backward_makes_a_strided_cotangent_dense():
    x = torch.randn(2, 4, 4, 6, requires_grad=True)
    out = P.max_pool3x3_s1(x)
    g = torch.randn(2, 4, 4, 12)[..., ::2]  # not contiguous
    (gi,) = torch.autograd.grad(out, x, g)
    (want,) = torch.autograd.grad(P.max_pool3x3_s1(x), x, g.contiguous())
    assert torch.equal(gi, want)


def test_cpu_tensors_never_launch(no_build):
    before = (P.FWD_LAUNCHES, P.BWD_LAUNCHES, D.LAUNCHES)
    x = torch.randn(1, 4, 4, 8, requires_grad=True)
    P.max_pool3x3_s1(x).sum().backward()
    D.depthwise_stencil(x.detach(), torch.randn(3, 3, 8))
    assert (P.FWD_LAUNCHES, P.BWD_LAUNCHES, D.LAUNCHES) == before


def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises: the
    plain versions are never its fallback (shown with a meta tensor, the
    one non-CPU device there is without a card)."""
    def unreachable(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(P, "max_pool3x3_s1_reference", unreachable)
    monkeypatch.setattr(P, "max_pool3x3_s1_backward_reference", unreachable)
    monkeypatch.setattr(D, "depthwise_stencil_reference", unreachable)
    x = torch.empty(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        P.max_pool3x3_s1(x)
    with pytest.raises(ValueError, match="CUDA"):
        P.max_pool3x3_s1(x.requires_grad_())
    with pytest.raises(ValueError, match="CUDA"):
        D.depthwise_stencil(x.detach(), torch.empty(3, 3, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        D.depthwise_stencil(x.detach(), torch.empty(3, 3, 8))  # mixed


def test_max_pool_refuses_a_non_contiguous_view():
    x = torch.randn(2, 8, 4, 4).permute(0, 2, 3, 1)  # NCHW-contiguous
    with pytest.raises(ValueError, match="contiguous"):
        P.max_pool3x3_s1(x)
    with pytest.raises(ValueError, match="NHWC"):
        P.max_pool3x3_s1(torch.randn(4, 4, 8))


@pytest.mark.parametrize("c,elem,offset,want", [
    (480, 2, 0, 8), (44, 2, 0, 4), (130, 2, 0, 2), (33, 2, 0, 1),
    (480, 4, 0, 4), (130, 4, 0, 2), (480, 2, 4, 4), (480, 2, 2, 2),
    (480, 2, 1, 1),
])
def test_vector_width_from_channels_and_alignment(c, elem, offset, want):
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    base = torch.empty(c * 4 + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    assert _build.vector_width(c, base[offset:]) == want


def test_common_max_pool_routes_3_1_1_to_the_op(monkeypatch):
    calls = []
    real = common.max_pool3x3_s1
    monkeypatch.setattr(
        common, "max_pool3x3_s1", lambda v: calls.append(v.shape) or real(v)
    )
    x = torch.randn(2, 6, 8, 8).contiguous(memory_format=torch.channels_last)
    got = common.max_pool(x, 3, stride=1, padding=1)
    assert calls == [(2, 8, 8, 6)]  # the NHWC view
    assert torch.equal(got, F.max_pool2d(x, 3, 1, 1))
    got = common.max_pool(x, 3, stride=2, padding=1)  # a stage transition
    assert len(calls) == 1
    assert torch.equal(got, F.max_pool2d(x, 3, 2, 1))
    assert torch.equal(common.max_pool(x, 2), F.max_pool2d(x, 2))
    # an NCHW-contiguous activation is made channels_last, not refused
    assert torch.equal(
        common.max_pool(x.contiguous(), 3, 1, 1), F.max_pool2d(x, 3, 1, 1)
    )


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
@pytest.mark.parametrize("k,c", [(7, 44), (5, 44), (3, 32), (3, 130)])
def test_depthwise_stencil_matches_jax(k, c, oracle, no_build):
    rs = np.random.RandomState(k * 100 + c)
    x = rs.standard_normal((2, 8, 8, c)).astype(np.float32)
    w = rs.standard_normal((k, k, c)).astype(np.float32)
    if oracle == "pallas":
        want = jax_depthwise_stencil(jnp.asarray(x), jnp.asarray(w), True)
    else:
        want = depthwise_xla(jnp.asarray(x), jnp.asarray(w))
    got = D.depthwise_stencil(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("h,w", [(4, 4), (2, 2), (1, 3)])
def test_depthwise_stencil_maps_smaller_than_the_halo(h, w):
    rs = np.random.RandomState(h * 10 + w)
    x = torch.from_numpy(rs.standard_normal((2, h, w, 6)).astype(np.float32))
    wt = torch.from_numpy(rs.standard_normal((7, 7, 6)).astype(np.float32))
    want = F.conv2d(x.permute(0, 3, 1, 2),
                    wt.permute(2, 0, 1).unsqueeze(1), padding=3, groups=6)
    torch.testing.assert_close(D.depthwise_stencil(x, wt),
                               want.permute(0, 2, 3, 1), rtol=2e-5, atol=2e-5)


def test_depthwise_stencil_bf16_sums_in_fp32_and_rounds_once():
    rs = np.random.RandomState(21)
    x = torch.from_numpy(rs.standard_normal((2, 6, 6, 16)).astype(np.float32))
    w = torch.from_numpy(rs.standard_normal((5, 5, 16)).astype(np.float32))
    xb, wb = x.bfloat16(), w.bfloat16()
    got = D.depthwise_stencil(xb, wb)
    assert got.dtype == torch.bfloat16
    want = D.depthwise_stencil_reference(xb.float(), wb.float()).bfloat16()
    assert torch.equal(got, want)


def test_depthwise_stencil_checks_its_arguments():
    x = torch.randn(1, 4, 4, 8)
    with pytest.raises(ValueError, match="k in"):
        D.depthwise_stencil(x, torch.randn(4, 4, 8))
    with pytest.raises(ValueError, match="expected"):
        D.depthwise_stencil(x, torch.randn(3, 3, 4))
    with pytest.raises(TypeError, match="x's type"):
        D.depthwise_stencil(x, torch.randn(3, 3, 8).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        D.depthwise_stencil(x, torch.randn(8, 3, 3).permute(1, 2, 0))


def test_build_table_names_every_source():
    """Each kernel source of ``ops/csrc`` has its entry points declared, so
    ``build_all`` compiles all five together."""
    assert sorted(_build.ENTRY_POINTS) == sorted(
        p.stem for p in _build.CSRC.glob("*.cu")
    )
    assert set(_build.ENTRY_POINTS["max_pool"]) == {
        f"max_pool3x3_{d}_{t}" for d in ("fwd", "bwd") for t in ("bf16", "f32")
    }
    src = (_build.CSRC / "max_pool.cu").read_text()
    for name in _build.ENTRY_POINTS["max_pool"]:
        assert f'extern "C" int {name}(' in src
