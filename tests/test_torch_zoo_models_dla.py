"""The port's SimpleDLA against the JAX package's, on the same seeded
weights: registry entry, parameter count, ``state_dict`` order, the JAX
call order of its trees, the mapping against the JAX export (and its
refusals of a tree that is not SimpleDLA's), eval logits in fp32 and bf16,
and its 12 fused sites per forward. Helpers in ``tests/_torch_zoo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
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
    jax_call_order,
    nested_copy,
    random_trees,
    reference_keys,
    trees,
)


@pytest.mark.parametrize("name,count", [("SimpleDLA", 15_142_970)])
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", ["SimpleDLA"])
def test_registered_and_no_longer_listed_as_unported(name):
    """The name is registered, and the registry is the JAX
    registry's (no name is left unported)."""
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", ["SimpleDLA"])
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


def test_jax_call_order_moves_each_root_after_its_children():
    keys = reference_keys("SimpleDLA")
    order = jax_call_order(keys)
    assert sorted(order) == sorted(keys) and order != keys
    where = {k: i for i, k in enumerate(order)}
    for k in keys:
        if ".root." in k:
            tree = k.split(".root.")[0]
            kids = [c for c in keys if c.startswith(
                (f"{tree}.left_tree.", f"{tree}.right_tree."))]
            assert kids and all(where[k] > where[c] for c in kids), k
    assert jax_call_order(reference_keys("MobileNet")) == \
        reference_keys("MobileNet")


@pytest.mark.parametrize("name", ["SimpleDLA"])
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


def test_state_dict_from_jax_refuses_a_resnet_tree_for_simpledla():
    model = jax_create_model("ResNet18")
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False
    ))
    params, stats = random_trees(shapes, 3)
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax("SimpleDLA", params, stats)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_dla_tree_with_a_leaf_off(edit,
                                                                trees):
    """SimpleDLA's branch raises on a missing leaf and on a leaf the model
    does not have, as the other branches do."""
    params, stats = trees("SimpleDLA")
    params, stats = nested_copy(params), nested_copy(stats)
    node = params["Tree_1"]["Tree_0"]["BasicBlock_1"]
    if edit == "missing":
        del node["BatchNorm_1"]["scale"]
    elif edit == "extra":
        node["Conv_2"] = {"Conv_0": {"kernel": np.zeros((1, 1, 128, 128),
                                                        np.float32)}}
    else:
        stats["Tree_3"]["BasicBlock_2"] = {
            "BatchNorm_0": {"mean": np.zeros(512, np.float32)}}
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax("SimpleDLA", params, stats)


@pytest.mark.parametrize("name", ["SimpleDLA"])
def test_eval_logits_match_jax_fp32(name, trees):
    check_eval_fp32(name, trees)


@pytest.mark.parametrize("name,he", [("SimpleDLA", True)])
def test_eval_logits_match_jax_bf16(name, he, trees):
    check_eval_bf16(name, he, trees)


@pytest.mark.parametrize("name", ["SimpleDLA"])
def test_bf16_error_no_worse_than_jax(name, trees):
    check_bf16_error(name, trees)


@pytest.mark.parametrize("name,fused,pools,stencils",
                         [("SimpleDLA", 12, 0, 0)])
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)
