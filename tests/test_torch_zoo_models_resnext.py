"""The port's ResNeXt29 (2x64d, 4x64d, 8x64d, 32x4d) against the JAX
package's, on the same seeded weights: registry entries, parameter counts,
``state_dict`` order, the mapping against the JAX export and back as raw
bits, eval logits in fp32 and bf16, and its kernel sites per forward (none:
the stem is 1x1 and the grouped 3x3s are not depthwise, so every site runs
``F.conv2d`` with its groups). Helpers in ``tests/_torch_zoo.py``.
"""

import pytest
import torch

from pytorch_cifar_tpu_torch.models import (
    available_models,
    count_params,
    create_model,
)
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

COUNTS = {"ResNeXt29_2x64d": 9_128_778, "ResNeXt29_4x64d": 27_104_586,
          "ResNeXt29_8x64d": 89_598_282, "ResNeXt29_32x4d": 4_774_218}
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


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


@pytest.mark.parametrize("name", ["ResNeXt29_2x64d"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("ResNeXt29_32x4d", edit, trees)


@pytest.mark.parametrize("name", ["ResNeXt29_32x4d"])
def test_eval_logits_match_jax_fp32(name, trees):
    """The JAX forward compiled: op by op, compiling each op first takes
    most of the test on the CPU."""
    check_eval_fp32(name, trees, jit=True)


@pytest.mark.parametrize("name", ["ResNeXt29_32x4d"])
def test_bf16_error_no_worse_than_jax(name, trees):
    """The JAX forwards compiled, as the JAX package's engine runs them."""
    check_bf16_error(name, trees, jit=True)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites(*NAMES))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


@pytest.mark.parametrize("name,cardinality", [("ResNeXt29_2x64d", 2),
                                              ("ResNeXt29_32x4d", 32)])
def test_grouped_sites_keep_their_groups(name, cardinality):
    """Each block's 3x3 folds with ``groups = cardinality`` (9 of them,
    stride 2 at two), every other site with one group."""
    sites = list(folded_sites(create_model(name).fold(torch.float32)))
    grouped = [s for s in sites if s.groups > 1]
    assert len(grouped) == 9
    assert all(s.groups == cardinality and s.weight.shape[2:] == (3, 3)
               for s in grouped)
    assert sum(s.stride == 2 for s in grouped) == 2
