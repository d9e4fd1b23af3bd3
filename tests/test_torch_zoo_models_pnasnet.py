"""The port's PNASNet A and B against the JAX package's, on the same
seeded weights: registry entries, parameter counts, ``state_dict`` order,
the mapping against the JAX export (its template in the JAX call order:
a stride-2 B cell calls its pool's 1x1 before ``sep_conv3``) and back as
raw bits, eval logits in fp32 and bf16, its kernel sites per forward (1
fused; 18 pools; 18 stencils in A, 54 in B; the stride-2 cells' separable
convs, with a channel multiplier of 2, stay on the library), and the
plain versions of K4 and K5 at PNASNet's channel counts against the JAX
kernels (Pallas, interpret mode). Helpers in ``tests/_torch_zoo.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.ops.depthwise_stencil import (
    depthwise_stencil as jax_depthwise_stencil,
)
from pytorch_cifar_tpu.ops.max_pool import max_pool3x3_s1 as jax_max_pool
from pytorch_cifar_tpu_torch.models import (
    available_models,
    common,
    count_params,
    create_model,
)
from pytorch_cifar_tpu_torch.models.pnasnet import SepConv
from pytorch_cifar_tpu_torch.ops import depthwise_stencil as D
from pytorch_cifar_tpu_torch.ops import max_pool as P
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (  # noqa: F401
    check_bf16_error,
    check_eval_fp32,
    check_export,
    check_kernel_sites,
    check_refuses_a_leaf_off,
    check_registry_is_the_jax_registry,
    check_round_trip,
    folded_sites,
    jax_call_order,
    kernel_sites,
    reference_keys,
    trees,
)

COUNTS = {"PNASNetA": 130_646, "PNASNetB": 451_626}


@pytest.mark.parametrize("name,count", list(COUNTS.items()))
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", list(COUNTS))
def test_registered_and_no_longer_listed_as_unported(name):
    """The name is registered, and the registry is the JAX
    registry's (no name is left unported)."""
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", list(COUNTS))
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


def test_jax_call_order_moves_the_pool_1x1_of_stride_2_b_cells():
    keys = reference_keys("PNASNetB")
    order = jax_call_order(keys)
    assert sorted(order) == sorted(keys) and order != keys
    for cell in ("layer2", "layer4"):
        assert order.index(f"{cell}.conv1.weight") < order.index(
            f"{cell}.sep_conv3.conv1.weight")
    assert jax_call_order(reference_keys("PNASNetA")) == \
        reference_keys("PNASNetA")


@pytest.mark.parametrize("name", list(COUNTS))
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


@pytest.mark.parametrize("name", list(COUNTS))
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("PNASNetB", edit, trees)


@pytest.mark.parametrize("name", list(COUNTS))
def test_eval_logits_match_jax_fp32(name, trees):
    check_eval_fp32(name, trees)


@pytest.mark.parametrize("name", ["PNASNetB"])
def test_bf16_error_no_worse_than_jax(name, trees):
    check_bf16_error(name, trees)


@pytest.mark.parametrize("name,fused,pools,stencils",
                         kernel_sites("PNASNetA", "PNASNetB"))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


def test_stencil_sizes_per_cell():
    for name, per_cell in (("PNASNetA", [7]), ("PNASNetB", [7, 3, 5])):
        sites = [s for s in folded_sites(create_model(name).fold(
            torch.float32)) if s.stencil]
        assert [s.weight.shape[0] for s in sites] == per_cell * 18
        assert all(s.act is None for s in sites)


def test_a_channel_multiplier_is_no_stencil_site():
    """A stride-2 cell's separable conv has ``groups = in``, ``out = 2 *
    in``: it fails the stencil test and keeps ``F.conv2d``, with the same
    values as the module; at stride 1 with a multiplier it would too."""
    g = torch.Generator().manual_seed(3)
    for stride in (2, 1):
        sep = SepConv(6, 12, 7, stride)
        common.reset_parameters(sep, g)
        with torch.no_grad():
            sep.bn1.running_mean.normal_(generator=g)
            sep.bn1.running_var.uniform_(0.5, 1.5, generator=g)
        sep.eval()
        f = sep.fold(torch.float32)
        assert not f.stencil and not f.fused and f.groups == 6
        x = torch.randn(2, 6, 8, 8, generator=g).contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad():
            torch.testing.assert_close(common.conv_bn(x, f), sep(x),
                                       rtol=1e-5, atol=1e-5)


def test_stride_2_pools_stay_on_the_library(monkeypatch):
    """A PNASNetA forward pools 18 times through K4 (the stride-1 cells)
    and twice through ``F.max_pool2d`` at 3 / 2 / 1 (the stride-2 cells)."""
    calls = []
    real = common.F.max_pool2d
    monkeypatch.setattr(common.F, "max_pool2d",
                        lambda *a: calls.append(a[1:]) or real(*a))
    with torch.no_grad():
        create_model("PNASNetA").eval()(torch.randn(1, 3, 32, 32))
    assert calls == [(3, 2, 1), (3, 2, 1)]


@pytest.mark.parametrize("c", [44, 88])
def test_pool_plain_version_at_pnasnet_channels_matches_the_jax_kernel(c):
    """K4's plain version, forward and backward, against the JAX Pallas
    kernel in interpret mode at PNASNetA's channel counts (narrow vectors
    in bf16): bit for bit, with integer cotangents keeping every gradient
    sum exact."""
    import jax

    rs = np.random.RandomState(c)
    x = rs.standard_normal((2, 8, 8, c)).astype(np.float32)
    g = rs.randint(-4, 5, (2, 8, 8, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_max_pool(v, True), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = P.max_pool3x3_s1(xt)
    (got_g,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


def test_stencil_plain_version_at_k7_8x8_matches_the_jax_kernel():
    """K5's plain version at PNASNetA's last stage (k = 7 on 8x8 maps of
    176 channels) against the JAX Pallas kernel in interpret mode: rtol/
    atol 2e-5, the JAX package's own tolerance."""
    rs = np.random.RandomState(176)
    x = rs.standard_normal((2, 8, 8, 176)).astype(np.float32)
    w = rs.standard_normal((7, 7, 176)).astype(np.float32)
    want = jax_depthwise_stencil(jnp.asarray(x), jnp.asarray(w), True)
    got = D.depthwise_stencil(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
