"""The port's EfficientNetB0 against the JAX package's, on the same seeded
weights: registry entry, parameter count (its 1,088 dead parameters
included), ``state_dict`` order, the mapping against the JAX export and
back as raw bits, eval logits in fp32 and bf16, its 12 stencil sites per
forward (k = 3 and 5, swish after the affine), swish, drop-connect and
dropout against the JAX arithmetic on one mask, and K5's plain version at
EfficientNet's k = 5 shapes against the JAX kernel (Pallas, interpret
mode). Helpers in ``tests/_torch_zoo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models import efficientnet as jax_eff
from pytorch_cifar_tpu.ops.depthwise_stencil import (
    depthwise_stencil as jax_depthwise_stencil,
)
from pytorch_cifar_tpu_torch.models import (
    available_models,
    common,
    count_params,
    create_model,
)
from pytorch_cifar_tpu_torch.models.efficientnet import B0
from pytorch_cifar_tpu_torch.ops import depthwise_stencil as D
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
    kernel_sites,
    reference_keys,
    trees,
)


@pytest.mark.parametrize("name,count", [("EfficientNetB0", 3_599_686)])
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", ["EfficientNetB0"])
def test_registered_and_no_longer_listed_as_unported(name):
    """The name is registered, and the registry is the JAX
    registry's (no name is left unported)."""
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", ["EfficientNetB0"])
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


@pytest.mark.parametrize("name", ["EfficientNetB0"])
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


@pytest.mark.parametrize("name", ["EfficientNetB0"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("EfficientNetB0", edit, trees)


@pytest.mark.parametrize("name", ["EfficientNetB0"])
def test_eval_logits_match_jax_fp32(name, trees):
    check_eval_fp32(name, trees)


@pytest.mark.parametrize("name", ["EfficientNetB0"])
def test_bf16_error_no_worse_than_jax(name, trees):
    check_bf16_error(name, trees)


@pytest.mark.parametrize("name,fused,pools,stencils",
                         kernel_sites("EfficientNetB0"))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


def test_stencil_sites_are_five_3x3_and_seven_5x5_with_swish():
    sites = [s for s in folded_sites(create_model("EfficientNetB0").fold(
        torch.float32)) if s.stencil]
    ks = [s.weight.shape[0] for s in sites]
    assert (ks.count(3), ks.count(5)) == (5, 7)
    assert all(s.act == common.SWISH for s in sites)
    assert sorted({s.weight.shape[2] for s in sites}) == [
        32, 144, 240, 480, 672, 1152]


def test_dead_expand_conv_takes_no_part_in_the_forward():
    """Block 0 (expand ratio 1) holds conv1/bn1 (1,088 parameters) and
    never calls them: no gradient reaches them and the dead BN's running
    statistics stay at their initial values in training."""
    model = create_model("EfficientNetB0").to(
        memory_format=torch.channels_last).train()
    dead = model.layers[0]
    assert dead.expand_ratio == 1
    assert sum(p.numel() for m in (dead.conv1, dead.bn1)
               for p in m.parameters()) == 1_088
    g = torch.Generator().manual_seed(0)
    with common.stochastic_draws(
            lambda shape, keep: torch.rand(shape, generator=g) < keep):
        model(torch.randn(4, 3, 32, 32)).sum().backward()
    assert dead.conv1.weight.grad is None and dead.bn1.weight.grad is None
    assert dead.conv2.weight.grad is not None
    assert torch.equal(dead.bn1.running_mean, torch.zeros(32))
    assert torch.equal(dead.bn1.running_var, torch.ones(32))


def test_train_forward_draws_only_through_the_draw_hook():
    """A train-mode forward without a draw function raises (it never
    falls back to the global RNG); eval draws nothing."""
    model = create_model("EfficientNetB0").train()
    with pytest.raises(RuntimeError, match="stochastic_draws"):
        model(torch.randn(2, 3, 32, 32))
    model.eval()
    with torch.no_grad():
        assert model(torch.randn(2, 3, 32, 32)).shape == (2, 10)


def test_swish_and_masks_match_the_jax_arithmetic():
    """swish within 1 ulp-scale rtol of the JAX ``swish`` (the two
    sigmoids round apart); drop-connect and dropout with one mask exactly
    as the JAX ``drop_connect`` and flax ``Dropout`` compute them."""
    rs = np.random.RandomState(7)
    x = rs.standard_normal((4, 5, 5, 6)).astype(np.float32) * 4
    np.testing.assert_allclose(
        common.swish(torch.from_numpy(x)).numpy(),
        np.asarray(jax_eff.swish(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    key = jax.random.PRNGKey(3)
    rate = 0.15
    want = np.asarray(jax_eff.drop_connect(key, jnp.asarray(x), rate))
    mask = np.array(jax.random.bernoulli(key, 1.0 - rate, (4, 1, 1, 1)))
    got = common.drop_connect(torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.from_numpy(mask).view(4, 1, 1, 1), rate)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    flat = x.reshape(4, -1)
    m2 = rs.uniform(size=flat.shape) < 0.8
    got = common.drop_connect(torch.from_numpy(flat), torch.from_numpy(m2),
                              0.2)
    np.testing.assert_array_equal(
        got.numpy(), np.where(m2, flat / np.float32(0.8), 0.0))


@pytest.mark.parametrize("h,c", [(2, 1152), (4, 672), (4, 480)])
def test_stencil_plain_version_at_k5_sites_matches_the_jax_kernel(h, c):
    """K5's plain version against the JAX Pallas kernel in interpret mode
    at EfficientNet's k = 5 maps no larger than the halo: rtol/atol 2e-5,
    the JAX package's own tolerance for it."""
    rs = np.random.RandomState(h * 1000 + c)
    x = rs.standard_normal((2, h, h, c)).astype(np.float32)
    w = rs.standard_normal((5, 5, c)).astype(np.float32)
    want = jax_depthwise_stencil(jnp.asarray(x), jnp.asarray(w), True)
    got = D.depthwise_stencil(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_configuration_is_the_jax_b0():
    assert dict(jax_eff.EfficientNetB0().cfg) == B0
