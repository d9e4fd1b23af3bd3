"""The port's MobileNet against the JAX package's, on the same seeded
weights: registry entry, parameter count, ``state_dict`` order, the
mapping against the JAX export, eval logits in fp32 and bf16, and its
kernel sites per forward (1 fused, 9 stencils). Helpers in
``tests/_torch_zoo.py``.
"""

import pytest

from pytorch_cifar_tpu_torch.models import (
    available_models,
    count_params,
    create_model,
)
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (  # noqa: F401
    check_bf16_error,
    check_eval_bf16,
    check_eval_fp32,
    check_export,
    check_kernel_sites,
    check_registry_is_the_jax_registry,
    reference_keys,
    trees,
)


@pytest.mark.parametrize("name,count", [("MobileNet", 3_217_226)])
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", ["MobileNet"])
def test_registered_and_no_longer_listed_as_unported(name):
    """The name is registered, and the registry is the JAX
    registry's (no name is left unported)."""
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", ["MobileNet"])
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


@pytest.mark.parametrize("name", ["MobileNet"])
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


@pytest.mark.parametrize("name", ["MobileNet"])
def test_eval_logits_match_jax_fp32(name, trees):
    check_eval_fp32(name, trees)


@pytest.mark.parametrize("name,he", [("MobileNet", False)])
def test_eval_logits_match_jax_bf16(name, he, trees):
    check_eval_bf16(name, he, trees)


@pytest.mark.parametrize("name", ["MobileNet"])
def test_bf16_error_no_worse_than_jax(name, trees):
    check_bf16_error(name, trees)


@pytest.mark.parametrize("name,fused,pools,stencils",
                         [("MobileNet", 1, 0, 9)])
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)
