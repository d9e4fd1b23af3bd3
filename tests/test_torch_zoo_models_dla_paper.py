"""The port's paper DLA against the JAX package's, on the same seeded
weights: registry entry, parameter count, ``state_dict`` order, the JAX
call order of its trees (each root after its children, each level-2
tree's ``prev_root`` before its ``level_1``), the mapping against the JAX
export and back as raw bits (and its refusals of a tree that is not
DLA's), eval logits in fp32 and bf16, and its 12 fused sites per forward.
Helpers in ``tests/_torch_zoo.py``.
"""

import pytest

from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
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
    jax_call_order,
    kernel_sites,
    reference_keys,
    trees,
)


@pytest.mark.parametrize("name,count", [("DLA", 16_291_386)])
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", ["DLA"])
def test_registered_and_no_longer_listed_as_unported(name):
    """The name is registered, and the registry is the JAX
    registry's (no name is left unported)."""
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", ["DLA"])
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


def test_jax_call_order_puts_prev_root_first_and_roots_last():
    keys = reference_keys("DLA")
    order = jax_call_order(keys)
    assert sorted(order) == sorted(keys) and order != keys
    where = {k: i for i, k in enumerate(order)}
    for k in keys:
        if ".root." in k:
            tree = k.split(".root.")[0]
            kids = [c for c in keys if c.startswith(tree + ".")
                    and ".root." not in c[len(tree):]]
            assert kids and all(where[k] > where[c] for c in kids), k
        if ".prev_root." in k:
            tree = k.split(".prev_root.")[0]
            level = [c for c in keys if c.startswith(tree + ".level_1.")]
            assert level and all(where[k] < where[c] for c in level), k


@pytest.mark.parametrize("name", ["DLA"])
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


@pytest.mark.parametrize("name", ["DLA"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("DLA", edit, trees)


@pytest.mark.parametrize("pair", [("DLA", "SimpleDLA"), ("SimpleDLA", "DLA")])
def test_the_two_dlas_refuse_each_others_trees(pair, trees):
    params, stats = trees(pair[1])
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax(pair[0], params, stats)


@pytest.mark.parametrize("name", ["DLA"])
def test_eval_logits_match_jax_fp32(name, trees):
    check_eval_fp32(name, trees)


@pytest.mark.parametrize("name", ["DLA"])
def test_bf16_error_no_worse_than_jax(name, trees):
    check_bf16_error(name, trees)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites("DLA"))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)
