"""The port's GoogLeNet against the JAX package's: its registry entry,
parameter count, ``state_dict`` order and cell plan, and
``compat.state_dict_from_jax`` against the JAX package's own
``compat.export_torch_state_dict`` on the same seeded trees.

The zoo's model tests are split by family so the tier-1 run spreads them
over its workers (helpers in ``tests/_torch_zoo.py``):
``test_torch_zoo_models_googlenet.py`` (GoogLeNet's forwards),
``..._inception.py`` (one Inception cell and the folds),
``..._mobilenet.py`` and ``..._dla.py``. Weights, BN statistics and inputs
come from numpy seeds; the JAX models run eagerly (no whole-model
compile). Tolerances: fp32 rtol 1e-4 (the frameworks sum convolutions in
other orders), bf16 2% of the largest logit (they round at other places).
"""

import pytest

from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.models import (
    available_models,
    count_params,
    create_model,
)
from pytorch_cifar_tpu_torch.models.googlenet import CELLS
from pytorch_cifar_tpu_torch.models.mobilenet import CFG
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (  # noqa: F401
    check_export,
    check_registry_is_the_jax_registry,
    reference_keys,
    trees,
)


@pytest.mark.parametrize("name,count", [("GoogLeNet", 6_166_250)])
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", ["GoogLeNet"])
def test_registered_and_no_longer_listed_as_unported(name):
    """The name is registered, and the registry is the JAX
    registry's (no name is left unported)."""
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", ["GoogLeNet"])
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


def test_cells_follow_the_jax_plan():
    from pytorch_cifar_tpu.models.googlenet import _CELLS as JAX_CELLS
    from pytorch_cifar_tpu.models.mobilenet import _CFG as JAX_CFG

    assert tuple(c if c is None else c[1] for c in CELLS) == JAX_CELLS
    assert CFG == JAX_CFG


@pytest.mark.parametrize("name", ["GoogLeNet"])
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


def test_state_dict_from_jax_refuses_another_models_tree(trees):
    params, stats = trees("MobileNet")
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax("GoogLeNet", params, stats)
