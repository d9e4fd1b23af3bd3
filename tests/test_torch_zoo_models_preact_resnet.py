"""The port's PreActResNet18/34/50/101/152 against the JAX package's, on the
same seeded weights: registry entries, parameter counts, ``state_dict``
order, the mapping against the JAX export (the template in the JAX call
order, where a block's projection comes first) and back as raw bits, eval
logits in fp32 and bf16, and its kernel sites per forward. The identity
shortcut must read the raw input, not the pre-activated one, which only the
logits show. Helpers in ``tests/_torch_zoo.py``.
"""

import pytest
import torch

from pytorch_cifar_tpu_torch.models import available_models, create_model
from pytorch_cifar_tpu_torch.models import count_params
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
    kernel_sites,
    reference_keys,
    trees,
)

# PreActResNet34/101/152 from jax.eval_shape of the JAX models (their
# docstring gives none; PreActResNet50's rounds to 23.51M)
COUNTS = {"PreActResNet18": 11_171_146, "PreActResNet34": 21_279_306,
          "PreActResNet50": 23_509_066, "PreActResNet101": 42_501_194,
          "PreActResNet152": 58_144_842}
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
    """PreActResNet50's first block: its shortcut and its ``conv3`` are
    both 64 -> 256 1x1 convs, told apart by name."""
    check_export(name, trees)


@pytest.mark.parametrize("name", ["PreActResNet34"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("name", ["PreActResNet50"])
def test_jax_checkpoint_round_trips_byte_identical(name, tmp_path):
    check_checkpoint_round_trip(name, tmp_path)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("PreActResNet18", edit, trees)


@pytest.mark.parametrize("name,he", [("PreActResNet18", True),
                                     ("PreActResNet50", False)])
def test_eval_logits_match_jax_fp32(name, he, trees):
    """PreActResNet50 (the stem fused with the first block's ``bn1``) on
    1 / sqrt(fan_in) kernels: on He kernels its 16 pre-activation blocks,
    with no BN after the last, grow the logits to ~1,500, where the two
    packages' fp32 sums differ by 1e-3 (7e-7 of the largest logit), beyond
    rtol 1e-4 at a logit of 7."""
    check_eval_fp32(name, trees, he, jit=True)


@pytest.mark.parametrize("name", ["PreActResNet18"])
def test_bf16_error_no_worse_than_jax(name, trees):
    """The JAX forwards compiled, as the JAX package's engine runs them."""
    check_bf16_error(name, trees, jit=True)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites(*NAMES))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


@pytest.mark.parametrize("name,stem_fused", [("PreActResNet18", False),
                                             ("PreActResNet50", True)])
def test_the_stem_fuses_only_where_nothing_reads_its_raw_output(
        name, stem_fused):
    """The basic models' first block adds the raw stem output (identity
    shortcut): the stem stays a plain conv and the block applies its own
    ``bn1``. The bottleneck models' first block projects from the activated
    tensor: the stem carries that ``bn1`` and a ReLU, and the block none."""
    folded = create_model(name).fold(torch.float32)
    stem, first = folded["stem"], folded["blocks"][0]
    assert stem.fused == stem_fused
    assert (stem.mul is None) != stem_fused
    assert (first["pre"] is None) == stem_fused
    assert (first["shortcut"] is None) != stem_fused
    assert all(b["pre"] is not None for b in folded["blocks"][1:])
