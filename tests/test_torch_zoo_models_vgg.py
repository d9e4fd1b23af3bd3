"""The port's VGG11/13/16/19 against the JAX package's, on the same seeded
weights: registry entries, parameter counts, ``state_dict`` order (the
reference's ``features.N`` indices, which count the ReLU and pool
entries), the mapping against the JAX export and back as raw bits, eval
logits in fp32 and bf16, its kernel sites per forward (every conv, its
bias folded once into the affine, down to 2x2 maps of 512 channels).
Helpers in ``tests/_torch_zoo.py``.
"""

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models.vgg import CFG as JAX_CFG
from pytorch_cifar_tpu_torch.models import (
    available_models,
    common,
    count_params,
    create_model,
)
from pytorch_cifar_tpu_torch.models.vgg import CFG
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (  # noqa: F401
    check_bf16_error,
    check_checkpoint_round_trip,
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

COUNTS = {"VGG11": 9_231_114, "VGG13": 9_416_010, "VGG16": 14_728_266,
          "VGG19": 20_040_522}
NAMES = list(COUNTS)


@pytest.mark.parametrize("name,count", list(COUNTS.items()))
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", NAMES)
def test_registered_as_in_the_jax_registry(name):
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


def test_configurations_follow_the_jax_plan():
    assert CFG == JAX_CFG


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


@pytest.mark.parametrize("name", ["VGG13"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("name", ["VGG11"])
def test_jax_checkpoint_round_trips_byte_identical(name, tmp_path):
    check_checkpoint_round_trip(name, tmp_path)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("VGG11", edit, trees)


@pytest.mark.parametrize("name", ["VGG11"])
def test_eval_logits_match_jax_fp32(name, trees):
    """The JAX forward compiled: op by op, compiling each op first takes
    most of the test on the CPU."""
    check_eval_fp32(name, trees, jit=True)


@pytest.mark.parametrize("name", ["VGG11"])
def test_bf16_error_no_worse_than_jax(name, trees):
    """The JAX forwards compiled, as the JAX package's engine runs them."""
    check_bf16_error(name, trees, jit=True)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites(*NAMES))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


def test_the_conv_bias_goes_into_the_affine_once():
    """A fused site's ``add`` is ``bn.bias + (conv.bias - mean) * mul``:
    the folded site equals conv + bias, then BN, then ReLU (fp32, rtol
    1e-5), so the bias is added once."""
    model = create_model("VGG11").eval()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-1, 1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-1, 1, generator=g)
            if isinstance(m, torch.nn.Conv2d):
                m.bias.uniform_(-2, 2, generator=g)
    conv, bn = model.features[0], model.features[1]
    site = next(folded_sites(model.fold(torch.float32)))
    assert site.fused and site.weight.shape == (3, 3, 3, 64)
    x = torch.randn(2, 3, 8, 8, generator=g).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        want = torch.relu(bn(conv(x)))
        got = common.conv_bn(x, site)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_last_fused_sites_run_on_2x2_maps_of_512():
    """The fourth pool leaves 2x2 maps: VGG16's last three sites (and
    VGG11's last two) run the kernel there, 512 -> 512."""
    for name, last in (("VGG11", 2), ("VGG16", 3)):
        shapes = []
        real = common.conv3x3_bn_relu

        def record(x, w, scale, bias, _real=real):
            shapes.append((x.shape[1], x.shape[2], w.shape[2], w.shape[3]))
            return _real(x, w, scale, bias)

        common.conv3x3_bn_relu = record
        try:
            with torch.no_grad():
                create_model(name).eval()(torch.zeros(1, 3, 32, 32))
        finally:
            common.conv3x3_bn_relu = real
        assert shapes[-last:] == [(2, 2, 512, 512)] * last
        assert (2, 2, 512, 512) not in shapes[:-last]
