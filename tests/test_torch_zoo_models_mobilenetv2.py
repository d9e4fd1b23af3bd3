"""The port's MobileNetV2 against the JAX package's, on the same seeded
weights: registry entry, parameter count, ``state_dict`` order, its stage
plan, the mapping against the JAX export and back as raw bits, eval
logits in fp32 and bf16, and its kernel sites per forward (1 fused, 14
stencils; its 3 stride-2 depthwise convs stay on the library). Helpers in
``tests/_torch_zoo.py``.
"""

import pytest
import torch

from pytorch_cifar_tpu_torch.models import (
    available_models,
    count_params,
    create_model,
)
from pytorch_cifar_tpu_torch.models.mobilenetv2 import CFG
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


@pytest.mark.parametrize("name,count", [("MobileNetV2", 2_296_922)])
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", ["MobileNetV2"])
def test_registered_and_no_longer_listed_as_unported(name):
    """The name is registered, and the registry is the JAX
    registry's (no name is left unported)."""
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", ["MobileNetV2"])
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


def test_stages_follow_the_jax_plan():
    from pytorch_cifar_tpu.models.mobilenetv2 import _CFG as JAX_CFG

    assert CFG == JAX_CFG


@pytest.mark.parametrize("name", ["MobileNetV2"])
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


@pytest.mark.parametrize("name", ["MobileNetV2"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("MobileNetV2", edit, trees)


@pytest.mark.parametrize("name", ["MobileNetV2"])
def test_eval_logits_match_jax_fp32(name, trees):
    check_eval_fp32(name, trees)


@pytest.mark.parametrize("name", ["MobileNetV2"])
def test_bf16_error_no_worse_than_jax(name, trees):
    check_bf16_error(name, trees)


@pytest.mark.parametrize("name,fused,pools,stencils",
                         kernel_sites("MobileNetV2"))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


def test_residuals_only_at_stride_1():
    """17 blocks: the 3 stride-2 ones add no residual; 4 of the stride-1
    ones change width and project through a 1x1 conv + BN."""
    folded = create_model("MobileNetV2").fold(torch.float32)["blocks"]
    assert len(folded) == 17
    assert sum(not b["residual"] for b in folded) == 3
    assert sum(b["shortcut"] is not None for b in folded) == 4
    sites = list(folded_sites(folded))
    assert sum(s.stride == 2 and s.groups > 1 for s in sites) == 3
