"""The port's ShuffleNetV2 (four widths) against the JAX package's, on the
same seeded weights: registry entries, parameter counts, ``state_dict``
order, the mapping against the JAX export and back as raw bits, eval
logits in fp32 (every width) and bf16, its kernel sites per forward (1
fused, 13 stencils; the down blocks' stride-2 depthwise convs stay on the
library), and the channel shuffle against the JAX one and the reference's
view/permute. Helpers in ``tests/_torch_zoo.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models.common import (
    channel_shuffle as jax_channel_shuffle,
)
from pytorch_cifar_tpu.models.shufflenetv2 import _CONFIGS as JAX_CONFIGS
from pytorch_cifar_tpu_torch.models import (
    available_models,
    common,
    count_params,
    create_model,
)
from pytorch_cifar_tpu_torch.models.shufflenetv2 import CONFIGS
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

COUNTS = {"ShuffleNetV2_0.5": 352_042, "ShuffleNetV2_1": 1_263_854,
          "ShuffleNetV2_1.5": 2_488_874, "ShuffleNetV2_2": 5_338_026}
NAMES = list(COUNTS)


@pytest.mark.parametrize("name,count", list(COUNTS.items()))
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", NAMES)
def test_registered_and_no_longer_listed_as_unported(name):
    """The name is registered, and the registry is the JAX
    registry's (no name is left unported)."""
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


def test_configurations_follow_the_jax_plan():
    assert set(CONFIGS) == set(JAX_CONFIGS)
    for size, (out_channels, blocks) in CONFIGS.items():
        assert out_channels == JAX_CONFIGS[size]["out_channels"]
        assert blocks == JAX_CONFIGS[size]["num_blocks"]


@pytest.mark.parametrize("name", ["ShuffleNetV2_0.5", "ShuffleNetV2_2"])
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


@pytest.mark.parametrize("name", ["ShuffleNetV2_1"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("ShuffleNetV2_0.5", edit, trees)


def test_widths_refuse_each_others_trees(trees):
    params, stats = trees("ShuffleNetV2_1")
    from pytorch_cifar_tpu_torch.compat import state_dict_from_jax

    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax("ShuffleNetV2_1.5", params, stats)


@pytest.mark.parametrize("name", NAMES)
def test_eval_logits_match_jax_fp32(name, trees):
    check_eval_fp32(name, trees)


@pytest.mark.parametrize("name", ["ShuffleNetV2_1"])
def test_bf16_error_no_worse_than_jax(name, trees):
    check_bf16_error(name, trees)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites(*NAMES))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


@pytest.mark.parametrize("name,widths", [
    ("ShuffleNetV2_0.5", {24, 48, 96}), ("ShuffleNetV2_1", {58, 116, 232}),
    ("ShuffleNetV2_1.5", {88, 176, 352}),
    ("ShuffleNetV2_2", {112, 244, 488})])
def test_stencils_run_on_half_of_each_stage(name, widths):
    sites = [s for s in folded_sites(create_model(name).fold(torch.float32))
             if s.stencil]
    assert {s.weight.shape[2] for s in sites} == widths
    assert all(s.act is None for s in sites)  # no ReLU after the depthwise


@pytest.mark.parametrize("c", [6, 116, 244])
def test_channel_shuffle_matches_jax_and_the_reference(c):
    rs = np.random.RandomState(c)
    x = rs.standard_normal((2, 3, 4, c)).astype(np.float32)  # NHWC
    want = np.asarray(jax_channel_shuffle(jnp.asarray(x), 2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last NCHW
    got = common.channel_shuffle(xt, 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    ref = xt.reshape(2, 2, c // 2, 3, 4).permute(0, 2, 1, 3, 4).reshape(
        2, c, 3, 4)  # the reference's ShuffleBlock
    assert torch.equal(got, ref)
    # an NCHW-contiguous input gives the same values
    assert torch.equal(common.channel_shuffle(xt.contiguous(), 2), ref)
